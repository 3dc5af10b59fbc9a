"""Experiments of the port, each a module run as
``python -m whvi_tpu_torch.experiments.<name>``:

- :mod:`~whvi_tpu_torch.experiments.run_scaling`: ELBO steps/s and
  predictive calls/s of a wide WHVI MLP against D on one card
  (``experiments/run_scaling.py``).
"""
