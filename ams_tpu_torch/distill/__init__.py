"""Selection strategies, label reduction and the scoring functions."""
