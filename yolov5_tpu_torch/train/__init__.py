"""Training: target assignment, loss, optimizer and EMA, the train step and
the training loop (``run``)."""
