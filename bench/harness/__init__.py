"""The benchmark's general code: cell lookup, traffic, drivers' records,
trace reading, the correctness check and the chip's peaks."""
