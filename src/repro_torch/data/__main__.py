"""``python -m repro_torch.data synthetic|criteo ...`` (see
``repro_torch/data/format.py`` for the subcommands)."""

from repro_torch.data.format import main

if __name__ == "__main__":
    main()
