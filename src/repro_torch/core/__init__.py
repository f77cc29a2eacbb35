"""The TConst core of the port."""
