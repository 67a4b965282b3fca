"""Corpus catalogs: pure path logic, no I/O beyond globbing."""
