"""Phase-2 candidate refinement bound to the port's jump scorer."""
