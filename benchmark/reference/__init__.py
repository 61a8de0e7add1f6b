"""The plain reference: the minnow codec, container and formats in numpy."""
