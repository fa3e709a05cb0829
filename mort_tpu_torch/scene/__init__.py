from .build import SceneData, SceneMeta, World, scene_from_numpy
from .types import MatH, ObjH, TexH

__all__ = ["SceneData", "SceneMeta", "World", "scene_from_numpy",
           "MatH", "ObjH", "TexH"]
