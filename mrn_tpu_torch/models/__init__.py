"""Serving modules of the port (SVTR recognizer, DM-Router, MRN ensemble)."""
