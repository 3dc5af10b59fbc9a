"""Experiments of the port, each a module run as
``python -m whvi_tpu_torch.experiments.<name>`` on one card (each
``main`` refuses to run without one; each ``run`` takes its device):

- :mod:`~whvi_tpu_torch.experiments.run_scaling`: ELBO steps/s and
  predictive calls/s of a wide WHVI MLP against D on one card
  (``experiments/run_scaling.py``);
- :mod:`~whvi_tpu_torch.experiments.run_toy_cubic` and
  :mod:`~whvi_tpu_torch.experiments.run_toy_polynomial`: the reference's
  two toy regressions (``experiments/run_toy_cubic.py``,
  ``run_toy_polynomial.py``);
- :mod:`~whvi_tpu_torch.experiments.run_mnist`: the Bayesian classifier of
  BASELINE config 4 on MNIST's IDX files or synthetic data
  (``experiments/run_mnist.py``);
- :mod:`~whvi_tpu_torch.experiments.run_baseline_configs`: BASELINE
  configs 3 (deep heteroscedastic) and 5 (large D) on data made from a
  seed (``experiments/run_baseline_configs.py``).
"""
