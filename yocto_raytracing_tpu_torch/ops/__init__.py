"""Ray-primitive math (``intersect``), the scene hit query (``traverse``),
its brute-force oracle (``brute``), the overlap query (``overlap``) and
the samplers (``sampling``)."""
