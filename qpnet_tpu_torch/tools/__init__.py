"""Tools of the port: reference-checkpoint conversion and the serving soak."""
