"""``python -m efficientq_tpu_torch {ptq,infer} ...``: the CLI
(``cli/entrance.py``)."""
from .cli.entrance import main

if __name__ == "__main__":
    main()
