"""The benchmark's plain reference: NumPy only.

It imports nothing of the program under test, of ``jax`` or of the JAX
package, and is handed only the inputs the program was handed (unit
identities, packet counts, thresholds, arrival times, the seed), never
anything the program computed from them.
"""
