"""index_recall: of the window's requests that the exact fp32 search
over the reference's copy of the cache would answer from the cache, the
share that the index search answered (``100 · hits / (hits + false
misses)``, the check's count of both). Nothing where no request of the
window had a cached answer to find."""


def read(run):
    due = run.hits + run.false_misses
    return 100.0 * run.hits / due if due else None
