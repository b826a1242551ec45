"""Root logger (reference: basicsr/utils/logger.py:113-149)."""

from __future__ import annotations

import logging

_FORMAT = '%(asctime)s %(levelname)s: %(message)s'


def get_root_logger(logger_name: str = 'edvr_tpu_torch',
                    log_level: int = logging.INFO,
                    log_file: str | None = None) -> logging.Logger:
    """The package logger: one stream handler, plus a file handler the
    first time a ``log_file`` is given."""
    logger = logging.getLogger(logger_name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
        logger.propagate = False
        logger.setLevel(log_level)
    if log_file is not None and not any(
            isinstance(h, logging.FileHandler) for h in logger.handlers):
        file_handler = logging.FileHandler(log_file, 'w')
        file_handler.setFormatter(logging.Formatter(_FORMAT))
        file_handler.setLevel(log_level)
        logger.addHandler(file_handler)
    return logger


def get_env_info() -> str:
    import torch
    cuda = (torch.cuda.get_device_name(0) if torch.cuda.is_available()
            else 'none')
    return (f'\nVersion Information:\n\tPyTorch: {torch.__version__}'
            f'\n\tCUDA: {torch.version.cuda}\n\tDevice 0: {cuda}')
