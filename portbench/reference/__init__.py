"""The plain reference of the benchmark and the comparisons that decide a
run's ``correct``.  It imports neither JAX nor anything of the program."""
