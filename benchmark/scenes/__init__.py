"""Scene descriptions, one file each, found by the name a configuration
gives under ``builder``: ``build(scene_params, World) -> World``, the
same calls on the program's ``World`` or on the reference's."""
