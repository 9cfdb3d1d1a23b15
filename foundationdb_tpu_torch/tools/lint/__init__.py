"""Static checks of the port: the torch-graph structural check of the
registered device programs (``torchir``) and its committed fingerprints
(``torchfingerprint``)."""
