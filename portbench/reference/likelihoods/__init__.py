"""The reference's likelihoods, one file a ``kind`` of a configuration's
``likelihood``; the harness loads ``<kind>.py`` by its path."""
