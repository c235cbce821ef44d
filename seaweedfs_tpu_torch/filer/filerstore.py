"""The filer store interface and its registry. The JAX package's
``filer/filerstore.py``: insert, update, find, delete, recursive child
delete and ordered listing; ``make_store(kind, **options)`` builds a
registered kind: the embedded ``memory``, ``sqlite`` and ``sharded``,
and the network stores ``redis``, ``mysql``, ``postgres``,
``cassandra`` and ``etcd``, each a wire client of its own over a socket
or ``http.client``."""

from __future__ import annotations

from typing import Dict, List, Optional, Type

from .entry import Entry


class FilerStore:
    name = "abstract"

    def initialize(self, **options):
        pass

    def insert_entry(self, entry: Entry) -> None:
        raise NotImplementedError

    def update_entry(self, entry: Entry) -> None:
        self.insert_entry(entry)

    def find_entry(self, full_path: str) -> Optional[Entry]:
        raise NotImplementedError

    def delete_entry(self, full_path: str) -> None:
        raise NotImplementedError

    def delete_folder_children(self, full_path: str) -> None:
        raise NotImplementedError

    def list_directory_entries(self, dir_path: str, start_file_name: str,
                               inclusive: bool,
                               limit: int) -> List[Entry]:
        raise NotImplementedError

    def close(self):
        pass


STORES: Dict[str, Type[FilerStore]] = {}


def register_store(cls: Type[FilerStore]) -> Type[FilerStore]:
    STORES[cls.name] = cls
    return cls


def make_store(name: str, **options) -> FilerStore:
    # the stores register themselves on import
    from . import (cassandra_store, etcd_store, memory_store,  # noqa: F401
                   mysql_store, postgres_store, redis_store, sharded_store,
                   sqlite_store)
    cls = STORES.get(name)
    if cls is None:
        raise ValueError(f"unknown filer store {name!r}; "
                         f"have {sorted(STORES)}")
    store = cls()
    store.initialize(**options)
    return store
