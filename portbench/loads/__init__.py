"""The loads: what a window drives.  A traffic mix names its load under
``load``; ``loads/<load>.py`` has a class ``Load`` with ``prepare`` (the
set-up: inputs and warm-up), ``step`` (one call of the program's entry:
returns the scenario-units it completed and its output),
``release`` (frees the program's state after the window), ``check`` (the
comparison with the reference of the window's first and last outputs) and ``spans`` (the
program's attributes the traced run times)."""
