"""Per-layer metric readers, one file per metric, named as the metric
(``metrics/<name>.py``, loaded by path).  Each has ``read(ctx)``, which
returns the metric's value or None where the run gave it nothing to read,
and may name in ``RANGES`` the program functions it needs wrapped in a
``record_function`` range during the traced run: ``{range: [(module,
attribute), ...]}``, each wrapped where its callers look it up."""
