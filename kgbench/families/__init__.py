"""One module a model family, named by a configuration file's ``family``:
how the program builds it, its reference, and its work counts."""
