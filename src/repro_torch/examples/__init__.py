"""The reference's examples (``examples/``) through the port's API:
``quickstart`` (the paper's two-line API on a tiny LM) and ``train_lm``
(the training driver with checkpoints, resume and the replan loop)."""
