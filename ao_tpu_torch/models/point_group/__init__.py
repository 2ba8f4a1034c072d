from .point_group import PointGroup, point_group_loss, propose_instances
