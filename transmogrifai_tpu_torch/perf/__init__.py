"""The learned cost model's parameters (the model itself is ROADMAP.md
queue 1, item 10)."""
