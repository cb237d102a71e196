"""The traffic's generators: scenes and scans made from the seed."""
