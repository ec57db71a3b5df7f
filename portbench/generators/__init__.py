"""Part of the portbench yardstick; see the modules."""
