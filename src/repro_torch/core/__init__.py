"""Paper math and the LSH index (port of repro/core, the slice's part)."""
