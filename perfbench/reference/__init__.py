"""The plain reference of each entry, in the module of the entry's name."""
