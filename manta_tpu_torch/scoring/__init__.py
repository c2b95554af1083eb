"""Evidence scoring: host forms and the device split-scan router."""
