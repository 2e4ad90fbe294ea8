"""Closed-form operation and byte counts, and the table of peaks."""
