r"""The port's counterparts of the scripts in ``examples/``: the same file
names, flags and printed quantities, on the card by default.

    python -m pypose_tpu_torch.examples.<name> [--device cpu] [flags]

See ``README.md`` in this directory.
"""
