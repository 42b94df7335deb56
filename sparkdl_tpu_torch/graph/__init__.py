"""Model functions: a model and the device it runs on, as one callable."""
