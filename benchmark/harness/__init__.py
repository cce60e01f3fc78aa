"""The benchmark's harness: manifest, inputs, the measured window, the
trace, the correctness check and the result line."""
