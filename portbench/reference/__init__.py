"""The plain reference that decides ``correct``.

Plain PyTorch in float32 with TF32 off, written from the WHVI equations
and nothing of the measured program: a radix-2 butterfly Walsh-Hadamard
transform (:mod:`.fwht`), the nets of a configuration file as functions
of a parameter dict (:mod:`.nets`), one file a likelihood
(:mod:`.likelihoods`, found by its ``kind``), and Adam with the decayed learning
rate (:mod:`.adam`). It imports neither ``whvi_tpu_torch`` nor the JAX
package, and takes nothing the program made: the harness hands both sides
the same parameters, data and noise, which the harness drew itself.
"""

from portbench.reference.adam import adam_steps, lr_at
from portbench.reference.fwht import fwht
from portbench.reference.nets import kl_total, layer_specs, reference_grads, sample_outputs

__all__ = [
    "adam_steps", "fwht", "kl_total", "layer_specs", "lr_at", "reference_grads",
    "sample_outputs",
]
