"""The language models' drivers: ``serve`` (batched prefill, then greedy
decode through the KV cache) and ``train`` (steps of the LM loss with
checkpoints and ``--resume``). Both run on the card unless given
``--device cpu``. ``mesh`` holds the production meshes' shapes and
``remesh``."""
