"""Paper-faithful butterfly tables, Fenwick tables and the prefix oracle."""
