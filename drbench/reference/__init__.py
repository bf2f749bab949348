"""Plain references, one a configuration kind, importing nothing of
the program."""
