"""Phase-2 candidate generation, assembly and refinement."""
