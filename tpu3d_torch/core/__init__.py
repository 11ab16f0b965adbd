"""Camera model helpers."""
