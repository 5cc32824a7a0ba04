"""The plain reference of the benchmark's pose-graph solves (``lm``) and
its group arithmetic (``lie``).  Imports nothing of the program."""
