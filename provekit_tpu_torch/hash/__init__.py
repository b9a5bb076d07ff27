from . import skyscraper

__all__ = ["skyscraper"]
