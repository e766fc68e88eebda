"""One module per way of driving the program, named by a traffic mix's
``entry``."""
