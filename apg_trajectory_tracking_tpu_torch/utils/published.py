"""Where the port's analysis and table runs may write.

The repo's ``README.md``, ``docs/`` and ``assets/`` hold the JAX package's
published results and shipped checkpoints. No run of the port writes
there: its tables, protocol JSON and promoted checkpoints go under the
git-ignored ``trained_models/`` (``OUT_ROOT``) or wherever the caller
names. :func:`refuse_published` is the one check every writer calls.
"""

import os

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# the default root of every artifact the port's analyses write
OUT_ROOT = os.path.join("trained_models", "tables")
_PUBLISHED_DIRS = ("docs", "assets")


def _inside(path, root):
    return path == root or path.startswith(root + os.sep)


def refuse_published(path, flag):
    """Raise SystemExit if ``path`` (symlinks resolved) is the repo's
    ``README.md`` or lies in its ``docs/`` or ``assets/``, or in the working
    directory's (a checkout run from elsewhere, or links into the repo);
    ``flag`` names the option that gave it."""
    real = os.path.realpath(path)
    published = real == os.path.realpath(os.path.join(REPO, "README.md"))
    for base in {REPO, os.getcwd()}:
        for name in _PUBLISHED_DIRS:
            published |= _inside(real, os.path.realpath(
                os.path.join(base, name)))
    if published:
        raise SystemExit(
            f"{flag} {path}: the port never writes the repo's README.md, "
            f"docs/ or assets/ (they hold the JAX package's published "
            f"results); write under {OUT_ROOT}/ or another directory"
        )
