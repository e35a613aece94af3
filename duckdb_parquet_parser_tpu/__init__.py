"""Former name of the `duckdb_parquet_parser` package, kept so that existing
imports keep working.  Importing a module under this name returns the very
module object of the new name, so the two names never hold two copies."""

import importlib
import importlib.abc
import importlib.util
import sys

import duckdb_parquet_parser as _pkg

_OLD, _NEW = __name__, _pkg.__name__


class _Alias(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    def find_spec(self, fullname, path=None, target=None):
        if fullname.startswith(_OLD + "."):
            return importlib.util.spec_from_loader(fullname, self)
        return None

    def create_module(self, spec):
        module = importlib.import_module(_NEW + spec.name[len(_OLD):])
        spec.loader_state = module.__spec__
        return module

    def exec_module(self, module):
        # the import system has just set the alias spec on the module; give
        # it back its own, which its relative imports resolve against
        module.__spec__ = module.__spec__.loader_state


sys.meta_path.insert(0, _Alias())
sys.modules[_OLD] = _pkg
