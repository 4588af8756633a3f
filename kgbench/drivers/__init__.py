"""One module a traffic driver, named by a traffic file's ``driver``."""
