"""Print every registered path with exists/dir/file status: an environment
preflight before long runs.

The counterpart of the JAX package's ``scripts/print_paths.py``, over the
port's registry (``paths.describe_paths``: the same names, variables and
defaults), with its lines. Like JAX's, it takes no arguments. Host code
only.

    python -m multimodal_moe_torch.cli.print_paths
"""

from __future__ import annotations


def main(argv=None) -> None:
    """Print the registry; ``argv`` is ignored, as JAX's script ignores its
    arguments."""
    from ..paths import describe_paths

    for name, info in describe_paths().items():
        status = "dir" if info["is_dir"] else "file" if info["is_file"] else "missing"
        print(f"{name:55s} {status:8s} {info['path']}")


if __name__ == "__main__":
    main()
