"""The golden samplers (PyTorch): HMC, NUTS and parallel tempering with
Stan-style warm-up adaptation, split-R-hat and ESS, and the WHVI g
posterior. Counterpart of :mod:`whvi_tpu.mcmc`, with the same exports.

Chains (and tempering rungs) are leading axes of every state tensor; a
log density takes positions with a leading walker axis and returns one
value a walker (:mod:`whvi_tpu_torch.mcmc.chains`). Samplers take a
``torch.Generator`` on the positions' device, or their random numbers as
tensors (``draws=``)."""

from whvi_tpu_torch.mcmc.chains import StructuredLogProb
from whvi_tpu_torch.mcmc.diagnostics import ess, split_rhat, summarize
from whvi_tpu_torch.mcmc.hmc import (
    HMCConfig,
    hmc_sample,
    hmc_sample_chains,
    make_whvi_g_log_posterior,
    moments,
)
from whvi_tpu_torch.mcmc.nuts import NUTSConfig, nuts_sample, nuts_sample_chains
from whvi_tpu_torch.mcmc.tempering import PTConfig, pt_sample, pt_sample_chains

__all__ = [
    "HMCConfig",
    "NUTSConfig",
    "PTConfig",
    "StructuredLogProb",
    "pt_sample",
    "pt_sample_chains",
    "ess",
    "hmc_sample",
    "hmc_sample_chains",
    "make_whvi_g_log_posterior",
    "moments",
    "nuts_sample",
    "nuts_sample_chains",
    "split_rhat",
    "summarize",
]
