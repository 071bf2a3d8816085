"""Where the port's analysis and table runs may write.

The repo's ``README.md``, ``docs/`` and ``assets/`` hold the JAX package's
published results and shipped checkpoints. No run of the port writes
there: its tables, protocol JSON and promoted checkpoints go under the
git-ignored ``trained_models/`` (``OUT_ROOT``) or wherever the caller
names. :func:`refuse_published` is the one check every writer calls.
"""

import fnmatch
import os

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# the default root of every artifact the port's analyses write
OUT_ROOT = os.path.join("trained_models", "tables")
_PUBLISHED_DIRS = ("docs", "assets")
# the JAX package's measurement records at the repo's root
_PUBLISHED_RECORDS = ("MULTIHOST_BENCH.json", "BENCH_*.json")


def _inside(path, root):
    return path == root or path.startswith(root + os.sep)


def refuse_published(path, flag):
    """Raise SystemExit if ``path`` (symlinks resolved) is the repo's
    ``README.md``, ``MULTIHOST_BENCH.json`` or a ``BENCH_*.json``, or lies
    in its ``docs/`` or ``assets/``, or in the working directory's (a
    checkout run from elsewhere, or links into the repo); ``flag`` names
    the option that gave it."""
    real = os.path.realpath(path)
    published = real == os.path.realpath(os.path.join(REPO, "README.md"))
    published |= os.path.dirname(real) == os.path.realpath(REPO) and any(
        fnmatch.fnmatchcase(os.path.basename(real), pattern)
        for pattern in _PUBLISHED_RECORDS)
    for base in {REPO, os.getcwd()}:
        for name in _PUBLISHED_DIRS:
            published |= _inside(real, os.path.realpath(
                os.path.join(base, name)))
    if published:
        raise SystemExit(
            f"{flag} {path}: the port never writes the repo's README.md, "
            f"MULTIHOST_BENCH.json, BENCH_*.json, docs/ or assets/ (they "
            f"hold the JAX package's published results); write under "
            f"{OUT_ROOT}/ or another directory"
        )
