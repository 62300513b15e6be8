"""How a cell's window drives the program, one module per kind
(``driver`` in ``workloads/<cell>.json``)."""
