"""Utilities: unit parsing, logging, counters, output-tree digests."""
