"""Evaluation drivers of trained checkpoints (counterparts of the repo's
``eval/ex1_burgers_eval.py``, ``eval/ex2_darcy_eval.py`` and
``eval/ex3_darcy_inv_eval.py``)."""
