"""Tools of the port: reference-checkpoint conversion, the serving soak and
objective evaluation."""
