"""Run logs: the structured events and the resume trims persistence
needs (runlog.py)."""
