"""Core runtime: simulated time, events, RNG, scheduler, controller.

Mirrors the responsibilities of the reference's ``src/main/core`` layer
(SURVEY.md §1 layer 3-4) with a GPU data plane.
"""
