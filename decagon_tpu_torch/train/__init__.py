"""Evaluation (the serving path); training arrives with a later slice."""
