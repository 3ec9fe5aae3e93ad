"""The benchmark's tests (CPU; the card's skip without one)."""
