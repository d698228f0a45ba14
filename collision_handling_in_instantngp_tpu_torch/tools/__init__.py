"""Measurement tools of the port: the sweep ladder of the streamed tail
(``sweep_probe``), the dot-rate and memory-rate probe (``mxu_probe``) and
an epoch trace (``profile_epoch``). Each runs on the card unless
``--device cpu`` is given."""
