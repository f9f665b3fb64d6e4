"""The state head's PDDL model (numpy only)."""
