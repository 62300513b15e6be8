"""Plain references of the configurations, and the comparisons that decide
``correct``.  Nothing here imports the program."""
