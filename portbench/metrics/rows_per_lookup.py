"""rows_per_lookup: embedding rows the index search gathered per lookup
in the window (``EngineStats.rows_gathered`` over the window's
``lookup_batch`` calls): a count of the search's work."""


def read(run):
    return run.rows_gathered / run.lookups if run.lookups else None
