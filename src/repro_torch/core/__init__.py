"""Core numerics: absmax barrier, ternary codes, LOP features and selection."""
