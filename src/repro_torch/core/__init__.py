"""Gate-program IR, arithmetic builders and the program table."""
