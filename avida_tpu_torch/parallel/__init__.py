"""Batching of several worlds on one device (multiworld.py)."""
