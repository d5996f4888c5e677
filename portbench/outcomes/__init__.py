"""Per-application completion rules (outcome.py), one file a class."""
