"""Uniform logging setup (the reference recipe's log format)."""

import logging

_FORMAT = "%(asctime)s (%(module)s:%(lineno)d) %(levelname)s: %(message)s"
_DATEFMT = "%m/%d/%Y %I:%M:%S"


def set_loglevel(verbose: int = 1) -> None:
    if verbose == 1:
        level = logging.INFO
    elif verbose > 1:
        level = logging.DEBUG
    else:
        level = logging.WARN
    logging.basicConfig(level=level, format=_FORMAT, datefmt=_DATEFMT)
    if verbose < 1:
        logging.warning("logging is disabled.")
