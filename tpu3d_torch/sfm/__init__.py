"""Pipeline stages and the hand-off types of the reconstruct stage."""
