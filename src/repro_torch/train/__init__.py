"""Training of the port's LM stack: the train and eval steps (``steps``) and
the fault-tolerant loop (``loop``)."""
