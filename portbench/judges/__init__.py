"""Judges: one per kind of call, each comparing the program's answers with
``portbench/reference.py``.  A judge imports nothing of the program."""
