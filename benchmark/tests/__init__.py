"""CPU tests of the benchmark; those marked gpu need a card."""
