"""Scripts that drive the benchmark's runs on the card: series of runs
into a JSONL file, and the readings the limits of `correct` are set
from."""
