from .search import search_database  # noqa: F401
