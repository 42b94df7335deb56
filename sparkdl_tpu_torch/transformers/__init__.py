"""Pipeline transformers and the batched execution engine under them."""
