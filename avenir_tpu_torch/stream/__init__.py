"""The streaming-decision tier's pieces that the port has so far: the
fold half of ``stream/posterior.py`` (the batch feedback replay)."""
