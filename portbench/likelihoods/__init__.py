"""The likelihoods of the configurations, one file a ``kind``: how the
port's net is built around it, its own parameters, what a predictive call
copies to the host, and the numbers that judge that answer against the
reference's (:mod:`portbench.reference.likelihoods`). The harness loads
``<kind>.py`` by its path."""
