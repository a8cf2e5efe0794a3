"""The roofline: H100 constants, an op counter over torch dispatch, and the
report over the records that chip_smoke.py's LM phase writes."""
