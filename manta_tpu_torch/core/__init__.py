"""Host-side core models and the phase-0 estimates."""
