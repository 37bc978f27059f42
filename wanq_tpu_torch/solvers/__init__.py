"""Flow-matching solvers."""
