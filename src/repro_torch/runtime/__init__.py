"""The serving engine (runtime/server.py), the training driver
(runtime/trainer.py) and its step monitor (runtime/monitor.py)."""
