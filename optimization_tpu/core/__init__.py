from . import compile_cache, problem, tree, types
