"""The inputs the benchmark makes from ``--seed`` and hands to both the
program and the reference: the model's weights and the training rows.
Nothing here imports the port."""
