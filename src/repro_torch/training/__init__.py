"""Training of the port on one card: the step (`training.train_step`) and
the fault-tolerant loop (`training.trainer`)."""
