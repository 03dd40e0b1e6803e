"""``python -m poppunk_tpu_torch`` — the main CLI entry point."""

from .cli.main import main

if __name__ == "__main__":
    main()
