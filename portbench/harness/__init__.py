"""The harness: one general runner a kind of traffic (render sessions,
training steps), fed by the data files that ``BENCHMARK.json`` names."""
