"""The continuous-training loop's parameters (the loop itself is ROADMAP.md
queue 1, item 10)."""
