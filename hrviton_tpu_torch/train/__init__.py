"""Training: checkpoints (``train/checkpoint.py``), the two stages' trainers
(``condition_trainer.py``, ``generator_trainer.py``), Adam with the decay
schedule (``optim.py``) and the train-state containers (``state.py``)."""
