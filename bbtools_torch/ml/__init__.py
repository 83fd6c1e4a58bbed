from .cellnet import CellNet, parse_bbnet, save_bbnet  # noqa: F401
