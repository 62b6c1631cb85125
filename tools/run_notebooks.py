#!/usr/bin/env python
"""Execute the example notebooks end-to-end (CI smoke job).

Runs each notebook in examples/ with nbclient in a temp working directory.
Set PTMCMC_NB_SMOKE=1 (the CI default) so the notebooks shrink their
iteration counts; the code path exercised is identical.
"""

import os
import sys
import tempfile
import time
from pathlib import Path

import nbformat
from nbclient import NotebookClient

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


def main():
    os.environ.setdefault("PTMCMC_NB_SMOKE", "1")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    # Make the package importable from the kernel's temp cwd even when it is
    # not pip-installed (local runs; CI installs -e).
    repo = str(EXAMPLES.parent)
    os.environ["PYTHONPATH"] = repo + os.pathsep + os.environ.get("PYTHONPATH", "")
    names = sys.argv[1:] or ["simple", "gaussian_likelihood", "curved_likelihood"]
    failures = []
    for name in names:
        path = EXAMPLES / f"{name}.ipynb"
        nb = nbformat.read(path, as_version=4)
        # Force the CPU backend from inside the kernel: the smoke run must
        # not take the card from a process that holds it.
        nb.cells.insert(
            0,
            nbformat.v4.new_code_cell(
                "import jax\njax.config.update('jax_platforms', 'cpu')"
            ),
        )
        t0 = time.time()
        print(f"[notebooks] executing {name}...", flush=True)
        with tempfile.TemporaryDirectory() as wd:
            client = NotebookClient(
                nb, timeout=1800, kernel_name="python3",
                resources={"metadata": {"path": wd}},
            )
            try:
                client.execute()
                print(f"[notebooks] {name} ok in {time.time() - t0:.1f}s", flush=True)
            except Exception as e:  # noqa: BLE001
                print(f"[notebooks] {name} FAILED: {e}", flush=True)
                failures.append(name)
    if failures:
        raise SystemExit(f"notebook execution failed: {failures}")


if __name__ == "__main__":
    main()
