"""Tools of the port that run on the card (the counterparts of ``tools/``)."""
