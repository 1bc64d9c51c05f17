"""The port's benchmark harness: cells read from BENCHMARK.json, inputs made
from the seed, the closed loop over the program's entry points, the trace
reduction, the frozen work model and the output check."""
