from .hocon import ConfigNode, load_config, parse_string  # noqa: F401
