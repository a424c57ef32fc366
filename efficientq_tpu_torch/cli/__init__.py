from .entrance import build_parser, main, merge_config  # noqa: F401
