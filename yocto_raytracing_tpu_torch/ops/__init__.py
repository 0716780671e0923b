"""Ray-primitive math (``intersect``) and the scene hit query (``traverse``)."""
