"""The port's tools: the CLI's span and flight-recorder surfaces
(``cli.py``) and the structural check of the registered device programs
(``lint/torchir.py``, ``lint/torchfingerprint.py``)."""
