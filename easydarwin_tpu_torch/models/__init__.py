"""Shape-stable device steps built from the ops tier (the relay half)."""
